"""Run one cell of the port's benchmark once, on the machine it starts on:

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

It sets up the cell (traffic from ``--seed``, weights from the
configuration's own seed, the cell's shapes warmed), measures for
``--seconds``, with ``--trace 1`` then runs a traced segment, frees the
program's state, compares what the timed path produced with the plain
reference, and prints one JSON line: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; last, ``checks``: each compared number beside its limit,
which also end standard error.

It exits non-zero and prints no result without a CUDA card (or with fewer
than the cell asks for), when a file of the cell is missing, or when
``jax``, ``jaxlib``, ``flax`` or ``mask_rcnn_tpu`` is loaded once the
window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import os.path as osp  # noqa: E402
import sys  # noqa: E402

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # the program's build caches live inside the checkout, at fixed paths
    cache = osp.join(ROOT, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = osp.join(cache, "torch")
    os.environ["TRITON_CACHE_DIR"] = osp.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    import torch

    from port_bench import harness, spec

    cell = spec.load(args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"port_bench: {args.workload} needs {cell.chips} CUDA "
              "device(s); none usable here", file=sys.stderr)
        return 2
    run = harness.Run(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda:0", T_START)
    result = harness.execute(run)
    found = harness.forbidden_modules()
    if found:
        print(f"port_bench: the run loaded {found}", file=sys.stderr)
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
