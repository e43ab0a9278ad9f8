"""Run one cell of the port's benchmark once and print its result as the
last line of standard output.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Exits non-zero, with no result, without a CUDA device (or fewer than the
cell asks for), when `jax`, `jaxlib`, `flax` or the JAX package is loaded
at the end, or where the program is missing. Builds and kernel caches stay
inside the checkout, at fixed paths.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / ".port_bench_cache" / sub)
os.environ["USE_FLAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--root", default=str(ROOT), help="checkout holding BENCHMARK.json")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    try:
        from port_bench import harness
    except ImportError as exc:
        print(f"cannot import the harness: {exc}", file=sys.stderr)
        return 2
    try:
        return harness.main(args, T_START)
    except ImportError as exc:
        print(f"no result: the program is missing ({exc})", file=sys.stderr)
        return 5


if __name__ == "__main__":
    sys.exit(main())
