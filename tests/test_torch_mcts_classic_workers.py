"""The port's classic MCTS with root-parallel workers (W = 2: R = B·W rows,
per-action root statistics merged over the workers) and the boxed-in
node, against the JAX package's in float64 on small_cfg, with the JAX key
chain's draws injected (helpers and tolerances of
tests/test_torch_mcts_classic.py; the boxed-in case keeps the
mission-config knobs there but its radius)."""

import numpy as np
import pytest

from test_torch_mcts_classic import B, assert_same_trees, search_both
from test_torch_zero_search import one_thread  # noqa: F401 (an autouse fixture)

CONFIGS = {  # name: (mission config fields beyond KNOBS, actions from JAX's plan itself)
    "w2": (dict(num_simulations=16, num_mcts_workers=2), False),
    "w2_gcb": (dict(num_simulations=16, num_mcts_workers=2, use_gcb_rollout=True), True),
}


@pytest.fixture(scope="module", params=list(CONFIGS))
def searched(request, small_cfg):
    fields, real_plan = CONFIGS[request.param]
    return search_both(small_cfg, fields, real_plan=real_plan)


def test_worker_trees_and_actions_match_jax(searched):
    jtrees, jactions, tree, actions, root, pp = searched
    assert_same_trees(tree, jtrees)
    np.testing.assert_array_equal(actions.numpy(), jactions)
    W, S = pp.num_workers, pp.num_simulations
    assert tree.parent.shape[0] == B * W and S == 8
    # each worker's root takes its own S simulations
    assert tree.visits[:, 0].tolist() == [float(S)] * (B * W)
    # the workers' trees differ, and the action maximises the merged mean
    assert not np.array_equal(tree.children[0].numpy(), tree.children[1].numpy())
    vis = root.visits.view(B, W, -1).sum(dim=1)
    val = root.values.view(B, W, -1).sum(dim=1)
    chosen = (val / vis.clamp(min=1e-30)).gather(1, actions[:, None])[:, 0]
    best = np.where(vis > 0, (val / vis.clamp(min=1e-30)).numpy(), -np.inf).max(axis=1)
    np.testing.assert_array_equal(chosen.numpy(), best)


def test_boxed_in_nodes_match_jax(small_cfg):
    """A radius below the grid's spacing leaves no action available at any
    node: the ε-branch expands a uniform action over all A
    (mcts_classic.py:128-133), a node's only child is then unaffordable at
    a small budget, UCT scores every slot −∞ and may take an empty one
    (child −1): the step moves along action 0 to node −1, which JAX's
    indexing wraps to the last node, and the backup credits the root
    (:266-270, :293, :347)."""
    fields = dict(num_simulations=16, num_mcts_workers=2, horizontal_spacing=3.0)
    jtrees, jactions, tree, actions, _, pp = search_both(small_cfg, fields,
                                                         budgets=(5.0, 7.0, 60.0), seed=3)
    assert_same_trees(tree, jtrees)
    np.testing.assert_array_equal(actions.numpy(), jactions)
    # the case was reached: a boxed-in root counted more visits than
    # simulations (the empty-slot edge credits it twice)
    assert (tree.visits[:4, 0] > pp.num_simulations).any()
