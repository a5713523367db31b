"""The port's engine bench twins beside the JAX package's engine benches on
one host, in one process tree.

    python3 engine_pairs.py [--out DIR]

For each pair, the twin runs first with the host's card in its clusters,
then the reference from a copy of the checkout under the gitignored
build/engine_pairs/, so that the repository's own BENCH_*.json are never
rewritten. The copy first builds the reference's native planes with
`make native`, as its bench.py does.

- bench: `python3 -m yoda_scheduler_tpu_torch.bench` / `bench.py`
- scale5k_huge: scale5k's 5,000-node leg alone (three runs at 64 shards,
  the fastest kept): the port's `tools/scale5k.huge_5000`, and the same
  leg through the top-level bench. The whole scale5k tool is not paired:
  its defrag leg does not end at 5,000 nodes in either engine.
- scale50k: `.tools.scale50k` / `tools/scale50k.py`
- serve50k_smoke: `.tools.serve50k --smoke` / `tools/serve50k.py --smoke`

Each run's output goes to DIR (default chiprun_out/engine/) as
<pair>.<side>.log, the twins' artifacts under DIR/port/ and the
reference's under DIR/jax/. One JSON line a pair (each side's exit code,
seconds and last stdout line), then the whole record, with the card's
name and power limit from nvidia-smi, in DIR/pairs.json. Exit 1 if a
twin failed; a reference that fails is recorded, not fatal.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
COPY = ROOT / "build" / "engine_pairs"
# what the copy leaves out: outputs, builds and the git store
COPY_IGNORE = shutil.ignore_patterns("chiprun_out", "build", ".git", "__pycache__")
# a limit for each run: the longest, serve50k --smoke, takes ~3 min
RUN_TIMEOUT_S = 1200.0
HUGE_KEYS = ("nodes", "pods", "bound", "wall_s", "wall_s_runs", "cycle_compute_p50_ms",
             "cycle_compute_p99_ms", "p50_ms")


def huge_leg(side: str) -> list[str]:
    """Interpreter arguments that run `huge_5000(side)` in a child."""
    return ["-c", f"import engine_pairs; engine_pairs.huge_5000({side!r})"]


# pair -> (the twin's interpreter arguments, the reference's, and the
# artifact both write, None for a pair that prints its result)
PAIRS = {
    "bench": (["-m", "yoda_scheduler_tpu_torch.bench"], ["bench.py"], "BENCH_FULL.json"),
    "scale5k_huge": (huge_leg("port"), huge_leg("jax"), None),
    "scale50k": (["-m", "yoda_scheduler_tpu_torch.tools.scale50k"], ["tools/scale50k.py"],
                 "BENCH_SCALE50K.json"),
    "serve50k_smoke": (["-m", "yoda_scheduler_tpu_torch.tools.serve50k", "--smoke"],
                       ["tools/serve50k.py", "--smoke"], "BENCH_SERVE50K_SMOKE.json"),
}


def huge_5000(side: str) -> None:
    """Print scale5k's 5,000-node leg on the port's engine with the host's
    card ("port") or on the JAX package's, from the copy ("jax")."""
    if side == "port":
        from yoda_scheduler_tpu_torch import bench
        from yoda_scheduler_tpu_torch.tools import scale5k

        live = bench.live_node()
        bench.build_native_planes()
        big = scale5k.huge_5000(live)
    else:
        import bench  # the top-level bench of the JAX package

        # tools/scale5k.py's leg, which that script runs only with the others
        runs = [bench.run_scale(625, shards=64) for _ in range(3)]
        big = min(runs, key=lambda r: r["wall_s"])
        big["wall_s_runs"] = sorted(r["wall_s"] for r in runs)
    print(json.dumps({k: big[k] for k in HUGE_KEYS}))


def card() -> str | None:
    """nvidia-smi's name and power limit of each card, or None without it."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return res.stdout.strip() if res.returncode == 0 else None


def copy_checkout(root: Path = ROOT, dest: Path = COPY) -> Path:
    """A fresh copy of the checkout at `dest`, for the reference to run in."""
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(root, dest, ignore=COPY_IGNORE)
    return dest


def run(cmd: list[str], cwd: Path, log: Path, timeout_s: float = RUN_TIMEOUT_S) -> dict:
    """Run `cmd` in `cwd` with its output in `log`. -> exit code, seconds
    and the last stdout line (parsed when it is JSON)."""
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=timeout_s)
        rc, out, err = res.returncode, res.stdout, res.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = "timeout", e.stdout or "", e.stderr or ""
        out, err = (s.decode() if isinstance(s, bytes) else s for s in (out, err))
    except OSError as e:  # no such program on this host
        rc, out, err = "not run", "", repr(e)
    seconds = time.perf_counter() - t0
    log.write_text(f"$ {' '.join(cmd)}\n{out}\n--- stderr ---\n{err}")
    lines = out.strip().splitlines()
    try:
        last = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        last = lines[-1]
    return {"rc": rc, "s": seconds, "last_line": last}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="engine bench twins beside the reference")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "engine"), metavar="DIR")
    out = Path(ap.parse_args(sys.argv[1:] if argv is None else argv).out)
    for side in ("port", "jax"):
        (out / side).mkdir(parents=True, exist_ok=True)
    smi = card()
    print(smi or "nvidia-smi: not available", flush=True)
    copy = copy_checkout()
    record = {"card": smi, "pairs": {},
              "jax_make_native": run(["make", "native"], copy, out / "make_native.jax.log")}
    for name, (port_args, jax_args, artifact) in PAIRS.items():
        port = run([sys.executable, *port_args]
                   + (["--out", str(out / "port")] if artifact else []), ROOT,
                   out / f"{name}.port.log")
        if artifact:  # the copy holds the repository's own: not this run's
            (copy / artifact).unlink(missing_ok=True)
        jax = run([sys.executable, *jax_args], copy, out / f"{name}.jax.log")
        if artifact and (copy / artifact).exists():
            shutil.copy(copy / artifact, out / "jax" / artifact)
        record["pairs"][name] = {"port": port, "jax": jax}
        print(json.dumps({"pair": name, "port": port, "jax": jax}), flush=True)
    (out / "pairs.json").write_text(json.dumps(record, indent=1))
    return 0 if all(p["port"]["rc"] == 0 for p in record["pairs"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
