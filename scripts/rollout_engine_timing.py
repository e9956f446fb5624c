"""Fused rollout kernel against XLA's direct path, on the GPU.

Times, in one process on one card, the two engines end to end (bench.py's
control-loop function at K=1000 x H=100 and K=16384 x H=64, and the
goal_seek episode at K=1000 x H=100) in the order direct, pallas, pallas,
direct, plus the rollout alone at several block widths. Prints one JSON
object per measurement.

    python scripts/rollout_engine_timing.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import bench  # noqa: E402
from husky_rover_mppi.mppi import MPPIConfig  # noqa: E402
from husky_rover_mppi.mppi import rollout as ro  # noqa: E402
from husky_rover_mppi.ops import rollout_pallas as rp  # noqa: E402
from husky_rover_mppi.utils import enable_compile_cache  # noqa: E402


def _emit(**rec):
    print(json.dumps(rec), flush=True)


def rollout_only(hf, K, H, engine, block_k, wheels=True, reps=20):
    """Seconds per rollout of K samples over H steps, jitted alone."""
    rng = np.random.default_rng(0)
    lin = jnp.asarray(rng.uniform(0, 2, (K, H)), jnp.float32)
    ang = jnp.asarray(rng.uniform(-1, 1, (K, H)), jnp.float32)
    pos = jnp.asarray([-60.0, -60.0], jnp.float32)
    hd = jnp.asarray([0.89, 0.45, 0.0], jnp.float32)
    if engine == "direct":
        fn = jax.jit(lambda l, a: ro.rollout_25d(hf, pos, hd, l, a, 0.045))
    else:
        n0 = jnp.asarray([0.0, 0.0, 1.0], jnp.float32)
        prev = hd - jnp.dot(hd, n0) * n0
        fn = jax.jit(lambda l, a: rp.rollout_chunk(
            hf, jnp.full((K,), pos[0]), jnp.full((K,), pos[1]),
            jnp.broadcast_to(prev, (K, 3)), l, a, 0.045, block_k=block_k,
            wheels=wheels))
    jax.block_until_ready(fn(lin, ang))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(lin, ang))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def main():
    if jax.default_backend() != "gpu":
        raise SystemExit("needs a GPU")
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    _emit(card=card.strip(), device=jax.devices()[0].device_kind)
    hf, cm = bench.build_world()

    rng = np.random.default_rng(1)
    for K, H in ((1000, 100), (16384, 64)):
        lin = jnp.asarray(rng.uniform(0, 2, (K, H)), jnp.float32)
        ang = jnp.asarray(rng.uniform(-1, 1, (K, H)), jnp.float32)
        pos = jnp.asarray([-60.0, -60.0], jnp.float32)
        hd = jnp.asarray([0.89, 0.45, 0.0], jnp.float32)
        ref = jax.jit(lambda l, a: ro.rollout_25d(hf, pos, hd, l, a, 0.045))(
            lin, ang)
        got = jax.jit(lambda l, a: ro.rollout_25d_pallas(
            hf, pos, hd, l, a, 0.045))(lin, ang)
        diffs = [float(jnp.max(jnp.abs(g - r))) for g, r in zip(got, ref)]
        _emit(what="check", K=K, H=H, max_abs_diff=diffs)

    for K, H in ((1000, 100), (16384, 64)):
        for bk in (32, 64, 128, 256):
            t = rollout_only(hf, K, H, "pallas", bk)
            _emit(what="rollout_only", K=K, H=H, engine="pallas",
                  block_k=bk, ms=t * 1e3)
        t = rollout_only(hf, K, H, "direct", 0)
        _emit(what="rollout_only", K=K, H=H, engine="direct",
              ms=t * 1e3)
        t = rollout_only(hf, 1, H, "direct", 0)
        _emit(what="rollout_only", K=1, H=H, engine="direct",
              ms=t * 1e3)
        t = rollout_only(hf, 1, H, "pallas", 128, wheels=False)
        _emit(what="rollout_only", K=1, H=H, engine="pallas",
              ms=t * 1e3)

    for K, H in ((1000, 100), (16384, 64)):
        for engine in ("direct", "pallas", "pallas", "direct"):
            cfg = MPPIConfig(num_samples=K, horizon=H, exact=False,
                             gather_engine=engine)
            t, sps = bench.bench_control_loop(hf, cm, cfg)
            _emit(what="control_loop", K=K, H=H, engine=engine,
                  ms=t * 1e3, rollout_steps_per_s=sps)

    for engine in ("direct", "pallas", "pallas", "direct"):
        cfg = MPPIConfig(num_samples=1000, horizon=100, exact=False,
                         gather_engine=engine)
        t, loops = bench.bench_goal_seek(hf, cm, cfg, max_loops=3500)
        _emit(what="goal_seek", K=1000, H=100, engine=engine,
              ms_per_loop=t * 1e3, loops=loops)

    # vmapped over rovers (the closed loop): 16 rovers, K=1000 x H=100
    from husky_rover_mppi.cli import main as cli_main
    t0 = time.perf_counter()
    cli_main(["mode=closed_loop", "num_rovers=16", "steps=60",
              "mppi.num_samples=1000", "mppi.horizon=100"])
    _emit(what="closed_loop_cli", s=time.perf_counter() - t0)


if __name__ == "__main__":
    main()
