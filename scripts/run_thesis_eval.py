"""Produce EVAL_r04.json: the thesis's 2D-vs-3D statistics experiment under
the thesis's OWN protocol.

Protocol (all matched to the reference, see
mppi/evaluation.py:run_thesis_protocol_experiment):
  terrain 150x150 m @0.1 m/px with craters 1/5 m^2 + 750-obstacle costmap;
  paired x/y-band traverses (MPPI_OO_current.py:756-768); thesis init
  (optimal_u=1, wheels=1 m/s, sigma base 0.3); slope weight 35.5 (the
  "reduced slope avoidance" condition of work summarise:58-60); BODY slope
  critic in both arms (the stats driver launches the 15-arg kernels with no
  wheel-track arrays, MPPI_OO_current.py:500-543); 3500-loop cap; per-path
  per-critic rescore with collision-abort and drop-5-greatest aggregation
  (evaluate_trajectory.py:80-196).

Also runs the mechanism ablation: the same comparison at K=500 with the
production *wheel* slope critic, which the 2D arm can never use (it degrades
to body) — quantifying the asymmetric nearest-cell-noise handicap that
flipped round-3's EVAL.json.

Usage (on the GPU):  python scripts/run_thesis_eval.py [runs_per_arm]
"""

import json
import sys
import time

sys.path.insert(0, ".")

from husky_rover_mppi.mppi.evaluation import (
    run_thesis_protocol_experiment,
)


def main():
    runs = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    t0 = time.time()
    table = run_thesis_protocol_experiment(
        ks=(350, 500, 1000),
        runs_per_arm=runs,
        max_loops=3500,
        gather_engine="auto",
    )
    table["config"]["gather_engine"] = "auto"
    import jax

    table["config"]["device"] = str(jax.devices()[0])

    # mechanism ablation: wheel-slope critic (production Isaac stack) gives
    # the 3D arm a handicap the 2D arm never pays (it degrades to body) —
    # same paired comparison with slope_critic="wheels" quantifies the
    # asymmetry that contributed to round-3's flipped EVAL.json
    ablation = run_thesis_protocol_experiment(
        ks=(500,),
        runs_per_arm=max(16, runs // 4),
        max_loops=3500,
        gather_engine="auto",
        slope_critic="wheels",
    )
    table["ablation"] = {
        "question": ("does the production wheel-slope critic (3D-only "
                     "nearest-cell noise) degrade the 3D arm relative to "
                     "the thesis-stats body critic?"),
        "wheels_critic_K500": ablation["per_k"][500],
    }
    table["config"]["wall_s"] = round(time.time() - t0, 1)
    with open("EVAL_r04.json", "w") as fh:
        json.dump(table, fh, indent=1)
    print(json.dumps({k: v["arms"] for k, v in table["per_k"].items()},
                     default=str))
    print(f"wrote EVAL_r04.json in {table['config']['wall_s']}s")


if __name__ == "__main__":
    main()
