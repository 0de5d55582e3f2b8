"""The frozen operation and byte counters, the bound, the busy union and
the FLOP count on hand-checked shapes."""

import torch

from benchmark import yardsticks as y


def test_operation_counts_by_hand():
    # M = 1: the pivot's clamp, sqrt and reciprocal; one more reciprocal
    assert y._cholesky_ops(1) == 3
    assert y._inverse_factor_ops(1) == 4
    assert y.inverse_ops(1) == 5
    assert y.trace_ops(1) == 6
    # M = 2: pivot 0 (3) + the entry below (1); pivot 1 (5); the factor's
    # reciprocals (2) and the one entry of L^-1 (3)
    assert y._cholesky_ops(2) == 9
    assert y._inverse_factor_ops(2) == 14
    assert y.inverse_factor_ops(2) == y.inverse_ops(2) + 9
    # the edge update for one mission at M = 1, N = 2, masked, no round trip:
    # 3 (symmetrise) + the inverse and its factor + 2 (U^T A) + 4 (squares,
    # sums, mask) + 1 (the gain's sum)
    assert y.edge_ops(1, 2, True, False) == 3 + y.inverse_factor_ops(1) + 2 + 4 + 1


def test_bytes_by_hand():
    assert y.trace_bytes(2, 3, 4, 4) == (2 * 2 * 3 * 4 + 2 * 4) * 4
    assert y.edge_bytes(2, 3, 5, 5, 4) == (2 * 9 + 2 * 2 * 3 * 5 + 2 + 6 + 5) * 4 + 16


def test_bound():
    assert y.bound(3.35e12, 0) == (1000.0, "bytes")
    assert y.bound(0, 67e12) == (1000.0, "operations")


def test_busy_union():
    busy, gaps = y.busy_union([(5, 6), (0, 2), (1, 3)])
    assert busy == 4 and gaps == [(3, 5)]


def test_network_flops_by_hand():
    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = torch.nn.Conv2d(1, 2, 3)
            self.fc = torch.nn.Linear(4, 3)

        def forward(self, x, mask):
            return self.conv(x), self.fc(mask)

    # conv: 2 × 3 × 3 outputs of 9 products; dense: 2 × 3 outputs of 4
    assert y.network_flops(Net(), torch.zeros(1, 1, 5, 5), torch.zeros(2, 4)) == 2 * 18 * 9 + 2 * 6 * 4


def test_count_calls_restores_the_method():
    class Box:
        def f(self):
            return 1

    box = Box()
    with y.count_calls(box, "f") as calls:
        box.f()
        box.f()
    assert calls == [2] and "f" not in vars(box) and box.f() == 1
