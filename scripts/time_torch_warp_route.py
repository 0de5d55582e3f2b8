"""Time the warp-route kernels (M = 13..32) of the PyTorch/CUDA port on one
card, at every M in float32 and float64: the two kinds of ``spd_inverse``
at (4096, M, M) and (256, M, M) and of ``spd_trace_product`` on the 2 m
grid's sweep pair shapes ((256, T, 400) + (400, T, 256)) against each
other, with ``kernels.warp_route("runtime_m")`` and
``kernels.warp_route("unrolled")``; and ``spd_inverse_factor`` at (1024,
M, M) and ``edge_factor_gain`` at (1024, M, 400) with a per-mission mask
(a descent step's shape on the 2 m grid), which have one kind.  The
default dispatch (``kUnrolledMaxM`` in csrc/smallchol.cu) takes the
unrolled K1 and K2 up to the largest M where they ran faster here; the
last line names, per kernel and dtype, the M where they did not.  With
``--lanes-probe`` it also builds and runs scripts/probe_torch_warp_lanes.cu:
the lane-per-block trace product's passes and the variants tried while
designing it, at M = 25 in float32; with ``--edge-probe``
scripts/probe_torch_edge_columns.cu: the edge update's factor kernel alone
and its two designs of Uᵀ·A and the gain, at M = 25, N = 400.

    python3 scripts/time_torch_warp_route.py [--m 13,25,32] [--lanes-probe] [--edge-probe]

Prints one line per (dtype, M) and writes ``chiprun_out/warp_route_times.json``.
Device times from a CUDA graph of several calls, replayed between CUDA
events; needs an NVIDIA Hopper card."""

import argparse
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from ipp_rl_tpu_torch.ops import kernels, smallchol  # noqa: E402

#: the probes: (source, the library part it is built with)
PROBES = {"lanes_probe": (ROOT / "scripts" / "probe_torch_warp_lanes.cu", 4),
          "edge_probe": (ROOT / "scripts" / "probe_torch_edge_columns.cu", 99)}


def graph_ms(fn, launches: int, replays: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * launches)


def random_spd(n: int, m: int, dtype: torch.dtype, gen: torch.Generator) -> torch.Tensor:
    A = torch.randn((n, m, m), generator=gen, device="cuda", dtype=dtype)
    return A @ A.mT + 0.5 * torch.eye(m, device="cuda", dtype=dtype)


def packed(S: torch.Tensor, outer: int, inner: int) -> torch.Tensor:
    t = smallchol.packed_size(S.shape[-1])
    return smallchol.pack_lower(S).view(outer, inner, t).transpose(1, 2).contiguous()


def edge_inputs(B: int, m: int, n: int, dtype: torch.dtype, gen: torch.Generator):
    """S_raw = A·Hᵀ, A = H·P (one SPD P), an R table of 7 actions, actions and
    a per-mission 0/1 mask."""
    X = torch.randn((n, n), generator=gen, device="cuda", dtype=torch.float64)
    P = X @ X.T / n + 0.1 * torch.eye(n, device="cuda", dtype=torch.float64)
    H = torch.randn((B, m, n), generator=gen, device="cuda", dtype=torch.float64) / n ** 0.5
    A = H @ P
    R = torch.rand((7, m), generator=gen, device="cuda", dtype=torch.float64) + 0.5
    a = torch.randint(0, 7, (B,), generator=gen, device="cuda")
    mask = (torch.rand((B, n), generator=gen, device="cuda") > 0.4).to(dtype)
    return (A @ H.mT).to(dtype), A.to(dtype), R.to(dtype), a, mask


#: the timed shapes of the kernels with two kinds, the keys of a row
KERNELS = ("inverse_4096", "inverse_256", "trace_pair")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--m", default=",".join(map(str, range(13, 33))),
                        help="comma-separated M of the warp route (default 13..32)")
    parser.add_argument("--lanes-probe", action="store_true",
                        help="also build and run scripts/probe_torch_warp_lanes.cu")
    parser.add_argument("--edge-probe", action="store_true",
                        help="also build and run scripts/probe_torch_edge_columns.cu")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA card with CUDA", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(12)
    rows = []
    for dtype in (torch.float32, torch.float64):
        for m in map(int, args.m.split(",")):
            S4096 = random_spd(4096, m, dtype, gen)
            S256 = random_spd(256, m, dtype, gen)
            n = 256 * 400
            pair = [(packed(random_spd(n, m, dtype, gen), o, i),
                     packed(random_spd(n, m, dtype, gen), o, i))
                    for o, i in ((256, 400), (400, 256))]
            S1024 = random_spd(1024, m, dtype, gen)
            edge = edge_inputs(1024, m, 400, dtype, gen)
            row = {"dtype": str(dtype)[6:], "M": m}
            for kind in kernels.WARP_ROUTES:
                with kernels.warp_route(kind):
                    row[f"inverse_4096_{kind}"] = graph_ms(lambda: kernels.spd_inverse(S4096), 50)
                    row[f"inverse_256_{kind}"] = graph_ms(lambda: kernels.spd_inverse(S256), 50)
                    row[f"trace_pair_{kind}"] = graph_ms(
                        lambda: [kernels.spd_trace_product_packed(a, b) for a, b in pair], 4)
            row["factor_1024"] = graph_ms(lambda: kernels.spd_inverse_factor(S1024), 50)
            row["edge_1024"] = graph_ms(lambda: kernels.edge_factor_gain(*edge), 20)
            rows.append(row)
            print(" ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                           for k, v in row.items()), flush=True)
            del pair, edge
    slower = {f"{k} {d}": [r["M"] for r in rows if r["dtype"] == d
                           and r[f"{k}_unrolled"] >= r[f"{k}_runtime_m"]]
              for k in KERNELS for d in ("float32", "float64")}
    print("unrolled not faster at M: " + json.dumps(slower), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "warp_route_times.json").write_text(json.dumps(
        {"card": card, "rows": rows, "unrolled_not_faster": slower}, indent=1))
    for flag, (source, part) in PROBES.items():
        if getattr(args, flag):
            binary = kernels.BUILD_DIR / source.stem
            kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
            flags = [f for f in kernels.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
            subprocess.run([kernels._nvcc(), *flags, f"-DSMALLCHOL_PART={part}", "-o",
                            str(binary), str(source)], check=True)
            print(subprocess.run([str(binary)], capture_output=True, text=True,
                                 check=True).stdout, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
