"""The YAML-subset reader in aux/config.py reads every file of the cfg/
tree as PyYAML's safe loader does, and the override values the CLI takes."""

from pathlib import Path

import pytest

from husky_rover_mppi.aux.config import dump_yaml, load_yaml, parse_value

CFG = Path(__file__).resolve().parent.parent / "cfg"
CFG_FILES = sorted(p.relative_to(CFG).as_posix() for p in CFG.rglob("*.yaml"))


def test_cfg_tree_is_listed():
    assert len(CFG_FILES) >= 20


@pytest.mark.parametrize("name", CFG_FILES)
def test_reader_matches_pyyaml(name):
    yaml = pytest.importorskip("yaml")
    text = (CFG / name).read_text()
    assert load_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("raw, value", [
    ("1000", 1000), ("-1.62", -1.62), ("0.0", 0.0), ("1e-3", "1e-3"),
    ("1.0e-3", 1.0e-3), ("true", True), ("off", False), ("~", None),
    ("direct", "direct"), ("'quoted: text'", "quoted: text"),
    ("[1, 2.5, x]", [1, 2.5, "x"]), ("{a: [1, 2], b: {c: d}}",
                                     {"a": [1, 2], "b": {"c": "d"}}),
])
def test_override_values(raw, value):
    assert parse_value(raw) == value


def test_nested_blocks_and_multiline_flow():
    text = """
# comment
a:
  b: 1   # trailing comment
  c:
    - x
    - {p: 1, q:
       [2, 3]}
    - k: v
      m: 'it''s'
d:
- 1
- 2
e: "hash # kept"
"""
    assert load_yaml(text) == {
        "a": {"b": 1, "c": ["x", {"p": 1, "q": [2, 3]},
                            {"k": "v", "m": "it's"}]},
        "d": [1, 2], "e": "hash # kept"}


def test_dump_round_trip():
    info = {"size": [150.0, 150.0], "pixel_size": [1e-05, 0.5],
            "center": [0, -3]}
    assert load_yaml(dump_yaml(info)) == info


_NO_EXTRAS = r"""
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("yaml", "matplotlib", "PIL", "cv2"):
            raise ImportError("blocked " + name)

sys.meta_path.insert(0, Block())
import jax
jax.config.update("jax_platforms", "cpu")
from husky_rover_mppi.cli import main
import husky_rover_mppi.env.largescale_loop
tiny = ["mppi.num_samples=16", "mppi.horizon=8", "world.grid_size=128",
        "world.costmap_size=64"]
assert main(["mode=standalone", "max_loops=2"] + tiny) == 0
assert main(["mode=closed_loop", "num_rovers=2", "steps=3"] + tiny) == 0
"""


def test_run_modes_need_no_yaml_package(tmp_path):
    """run.py's modes start with YAML and plotting packages unimportable."""
    import os
    import subprocess
    import sys

    root = Path(__file__).resolve().parent.parent
    # one CPU device and one compute thread: the child stays light beside
    # the other test workers
    env = dict(os.environ, PYTHONPATH=str(root), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false")
    proc = subprocess.run([sys.executable, "-c", _NO_EXTRAS], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
