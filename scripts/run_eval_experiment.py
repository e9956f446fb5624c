"""Produce EVAL.json: the thesis's 2D-vs-3D experiment at statistical scale.

Reproduces the headline claim of the reference thesis (`work summarise:47-60`
+ stats_results.py:8-80): 3D surface-riding projection yields lower total
cost and fewer collisions than the 2D planar baseline, with the gap widening
at lower sample counts. 64 runs per arm at K in {350, 500, 1000}, paired
start/goal draws, trimmed-mean aggregation — run on the GPU, where the
"auto" engine takes the fused rollout kernel.

Usage (on the GPU):  python scripts/run_eval_experiment.py [runs_per_arm]
"""

import json
import sys
import time

sys.path.insert(0, ".")

from husky_rover_mppi.mppi.evaluation import (
    run_2d_vs_3d_experiment,
)


def main():
    runs = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    t0 = time.time()
    # ~65 m paired traverses (jittered) complete within the loop cap at the
    # rover's realized ~0.05 m/loop; the thesis's 200 m runs would need a
    # 4000+ cap and ~4x the device time for the same statistics.
    table = run_2d_vs_3d_experiment(
        ks=(350, 500, 1000),
        runs_per_arm=runs,
        max_loops=2000,
        span_fraction=0.45,
        gather_engine="auto",
    )
    table["config"]["gather_engine"] = "auto"
    table["config"]["wall_s"] = round(time.time() - t0, 1)
    import jax

    table["config"]["device"] = str(jax.devices()[0])
    with open("EVAL.json", "w") as fh:
        json.dump(table, fh, indent=1)
    print(json.dumps({k: v["collisions"] for k, v in table["per_k"].items()}))
    print(f"wrote EVAL.json in {table['config']['wall_s']}s")


if __name__ == "__main__":
    main()
