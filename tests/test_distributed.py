"""Real multi-process multi-host proof (SURVEY §4: multi-host tests runnable
on CPU via ``jax.distributed`` + ``xla_force_host_platform_device_count``).

Two OS processes, 4 virtual devices each, one 8-device global mesh: the
sharded MPPI step must produce exactly the unsharded step's numbers on every
process's addressable shards — the cross-host correctness half of the
BASELINE multi-host target (throughput scaling needs real chips; numerical
equality is hardware-independent)."""

import subprocess
import sys
import socket
from pathlib import Path

WORKER = r'''
import os, sys
port, pid, sync_dir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                           num_processes=2, process_id=pid)
assert jax.device_count() == 8 and jax.local_device_count() == 4

import functools
import numpy as np
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from husky_rover_mppi.core import HeightField
from husky_rover_mppi.mppi import (
    ControllerState, MPPIConfig, RobotState, mppi_step,
)
from husky_rover_mppi.parallel.mesh import sharded_mppi_step
from husky_rover_mppi.terrain import as_costmap, crater_surface

dtype = jnp.float64
hw = 25.0
z = crater_surface(128, hw, [((-5.0, 8.0), 1.5, 8.0)], dtype=dtype)
hf = HeightField.create(z, hw, dtype=dtype)
rng = np.random.default_rng(1)
cm = as_costmap(rng.uniform(0, 0.9, (16, 16)) ** 4, hw, dtype=dtype)
config = MPPIConfig(num_samples=64, horizon=12, exact=True)
goal = jnp.asarray([10.0, 8.0], dtype)
robot = RobotState.create(-9.0, -7.0, [1.0, 0.3, 0.0], dtype=dtype)
ctrl = ControllerState.create(config, dtype)
noise_np = np.random.default_rng(7).normal(
    size=(2, config.num_samples, config.horizon))

mesh = jax.make_mesh((8,), ("sample",))
noise = jax.make_array_from_callback(
    noise_np.shape, NamedSharding(mesh, P(None, "sample", None)),
    lambda idx: noise_np[idx],
)
step = jax.jit(functools.partial(sharded_mppi_step, config, mesh))
new_ctrl, out = step(hf, cm, goal, robot, ctrl, noise)
jax.block_until_ready(out.costs)

# local unsharded reference (identical on both processes)
ref_ctrl, ref_out = mppi_step(config, hf, cm, goal, robot, ctrl,
                              jnp.asarray(noise_np, dtype))
ref_costs = np.asarray(ref_out.costs)

for shard in out.costs.addressable_shards:
    np.testing.assert_allclose(
        np.asarray(shard.data), ref_costs[shard.index], rtol=1e-12)
# the optimal input sequence is fully replicated after the psum
for shard in new_ctrl.optimal_u1.addressable_shards:
    np.testing.assert_allclose(
        np.asarray(shard.data), np.asarray(ref_ctrl.optimal_u1), atol=1e-12)
for shard in out.optimal_trajectory.addressable_shards:
    np.testing.assert_allclose(
        np.asarray(shard.data), np.asarray(ref_out.optimal_trajectory),
        atol=1e-10)

# --- weak-scaling throughput: same per-process sample batch on a local
# 4-device mesh (1 process) vs the 8-device global mesh (2 processes).
# BASELINE target 3 asks for a recorded cross-process number; on this
# 2-core CPU host the figure is oversubscription-bound, but it pins the
# measurement harness a pod run can re-use.
import time

PER_PROC = 512  # samples each process contributes


def timed_steps(mesh_, num_samples, n):
    cfgw = MPPIConfig(num_samples=num_samples, horizon=12, exact=True)
    ctrlw = ControllerState.create(cfgw, dtype)
    noise_w = np.random.default_rng(9).normal(
        size=(2, num_samples, cfgw.horizon))
    nz = jax.make_array_from_callback(
        noise_w.shape, NamedSharding(mesh_, P(None, "sample", None)),
        lambda idx: noise_w[idx],
    )
    stepw = jax.jit(functools.partial(sharded_mppi_step, cfgw, mesh_))
    c = ctrlw
    c, o = stepw(hf, cm, goal, robot, c, nz)     # compile
    jax.block_until_ready(o.costs)
    t0 = time.perf_counter()
    for _ in range(n):
        c, o = stepw(hf, cm, goal, robot, c, nz)
    jax.block_until_ready(o.costs)
    return (time.perf_counter() - t0) / n


local_mesh = jax.sharding.Mesh(np.array(jax.local_devices()), ("sample",))
# The global arm needs both processes stepping together (that IS the
# measurement). The local arm must be uncontended: on a 2-core host a
# sibling process timing its own local arm concurrently inflates the
# baseline and fabricates >1 'efficiency' (ADVICE r03). File-flag barrier:
# pid 1 idles (sleep-poll, ~no CPU) while pid 0 times the local arm, then
# roles swap so both workers stay in lockstep for process teardown.
from pathlib import Path as _P
def _flag(name):
    _P(sync_dir, name).touch()
def _wait(name, timeout=180.0):
    import time as _t
    t0 = _t.time()
    while not _P(sync_dir, name).exists():
        if _t.time() - t0 > timeout:
            raise TimeoutError(name)
        _t.sleep(0.05)

t_global = timed_steps(mesh, PER_PROC * 2, 4)           # same share x 2 procs
_flag(f"global_done_{pid}"); _wait(f"global_done_{1-pid}")
if pid == 0:
    t_local = timed_steps(local_mesh, PER_PROC, 4)      # uncontended
    _flag("local0_done")
else:
    _wait("local0_done")
    t_local = timed_steps(local_mesh, PER_PROC, 4)
if pid == 0:
    import json
    print("THROUGHPUT " + json.dumps({
        "per_process_samples": PER_PROC,
        "local_4dev_step_s": round(t_local, 4),
        "global_2proc_8dev_step_s": round(t_global, 4),
        "weak_scaling_efficiency": round(t_local / t_global, 3),
    }), flush=True)
print(f"WORKER_OK {pid}", flush=True)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_distributed_equality(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    port = str(_free_port())
    repo = str(Path(__file__).parent.parent)
    env = dict(
        PATH=sys.prefix + "/bin:/usr/bin:/bin",
        PYTHONPATH=repo,
        HOME="/root",
    )
    sync_dir = tmp_path / "sync"
    sync_dir.mkdir()
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), port, str(pid), str(sync_dir)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=repo,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"
        assert f"WORKER_OK {pid}" in out, out[-3000:]

    # append the cross-process weak-scaling row to the gitignored run log
    # (BASELINE target 3: a number a pod run can be compared against; on
    # this 2-core host it is oversubscription-bound). The committed
    # SCALING.json is only updated by the explicit scripts/update_scaling.py
    # merge — a test run never dirties the tree (ADVICE/VERDICT r03).
    import json

    line = next(l for l in outs[0].splitlines() if l.startswith("THROUGHPUT "))
    row = json.loads(line[len("THROUGHPUT "):])
    assert row["weak_scaling_efficiency"] > 0.2, row
    runs_path = Path(__file__).parent.parent / "SCALING_RUNS.jsonl"
    with open(runs_path, "a") as fh:
        fh.write(json.dumps({"two_process_weak_scaling": row}) + "\n")
