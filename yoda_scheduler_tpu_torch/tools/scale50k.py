"""The 50k-node data-plane tier: 50_000 nodes / 50_000 pods
drained by one engine with the full data plane on — pool-sharded
ColumnarTable (columnarShards), native fused kernel, batch commits. The
port's twin of the JAX package's tools/scale50k.py.

What the artifact (BENCH_SCALE50K.json) must show:

- the tier COMPLETES with bounded memory (peak RSS recorded and fenced
  in CI against a generous ceiling — reservoir histograms keep the
  metric families O(1) in pod count, the columnar table is ~tens of MB
  at this node count);
- cycle-compute p50 stays FLAT vs the 5k tier (the per-cycle scan is
  memo/native-served; node count must not leak back into it);
- drain wall / binds-per-second, the aggregate-throughput headline.

Run:  python3 -m yoda_scheduler_tpu_torch.tools.scale50k           (full 50k tier)
      python3 -m yoda_scheduler_tpu_torch.tools.scale50k --smoke   (12.5k-node tier)

Departures (bench.py's): the host's card, read through NVML, joins both
clusters (`--cpu` builds the JAX package's; without NVML and without
`--cpu` the run raises); the native planes must build and load; the
artifact goes to `chiprun_out/engine/` or `--out DIR`, never the
repository's root, and gains `live_node`.
"""

from __future__ import annotations

import json
import resource
import sys

from ..bench import (build_native_planes, engine_args, live_node, live_summary,
                     run_scale, write_artifact)

SHARDS = 64


def peak_rss_mb() -> float:
    """Peak RSS of this process (Linux ru_maxrss is in KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def run(smoke: bool, live=None) -> dict:
    """The artifact: the 5k tier with the same knobs, then the 50,000-node
    drain (12,504 with `smoke`), each with the `live` node when given."""
    # units are 8 nodes each (bench.build_scale_nodes); one pod per node
    # keeps the pod count — and with it the drain — bounded while every
    # row of the 50k-node table is still live scan input
    units = 1563 if smoke else 6250          # 12_504 / 50_000 nodes
    ref = run_scale(625, shards=SHARDS, live=live)      # the 5k tier, same knobs
    big = run_scale(units, pods_per_node=1, shards=SHARDS, live=live)
    rss = peak_rss_mb()
    # flatness is judged on PER-POD scheduling compute (the e2e stamp:
    # every attempt's pre-commit work for each bound pod). The raw
    # cycle_latency p50 is a cycle-MIX statistic — at one pod per node
    # nearly every cycle is a full 32-member batch commit, while the 5k
    # tier's median cycle is a cheap memo retry — so comparing it across
    # tiers compares different units of work.
    per_pod = (big.get("e2e_breakdown") or {}).get("cycle_compute_p50_ms")
    per_pod_ref = (ref.get("e2e_breakdown") or {}).get(
        "cycle_compute_p50_ms")
    # 2.5x slack: the per-pod stamp folds batch-member wait (which moves
    # with batch composition and host phase), so same-code runs vary
    # ~2x; against the 4x node-count step, staying inside 2.5x is still
    # an unambiguous sub-linearity verdict
    flat = (per_pod is not None and per_pod_ref is not None
            and per_pod <= max(2.5 * per_pod_ref, 1.0))
    return {
        "metric": "scale50k_drain",
        "smoke": smoke,
        "nodes": big["nodes"],
        "pods": big["pods"],
        "wall_s": big["wall_s"],
        "binds_per_s": round(big["bound"] / max(big["wall_s"], 1e-9), 1),
        "cycle_compute_per_pod_p50_ms": per_pod,
        "cycle_compute_per_pod_p50_ms_5k": per_pod_ref,
        "cycle_compute_flat_vs_5k": flat,
        "peak_rss_mb": round(rss, 1),
        "columnar_shards": SHARDS,
        "ref_5k": {k: ref[k] for k in ("nodes", "pods", "wall_s",
                                       "cycle_compute_p50_ms", "bound",
                                       "p50_ms")},
        "tier": big,
        "live_node": live_summary(live, pods_on_it=big["on_live_node"],
                                  pods_on_it_5k=ref["on_live_node"]),
    }


def main(argv=None) -> int:
    ap = engine_args("the 50k-node drain (the port's engine)")
    ap.add_argument("--smoke", action="store_true", help="the 12,504-node tier")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    live = live_node(args.cpu)
    build_native_planes()
    out = run(args.smoke, live)
    name = "BENCH_SCALE50K_SMOKE.json" if args.smoke else "BENCH_SCALE50K.json"
    write_artifact(args.out, name, out)
    print(json.dumps({k: out[k] for k in (
        "metric", "nodes", "pods", "wall_s", "binds_per_s",
        "cycle_compute_per_pod_p50_ms", "cycle_compute_flat_vs_5k",
        "peak_rss_mb")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
