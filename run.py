"""Framework entry point (the reference's run.py equivalent)."""
from husky_rover_mppi.cli import main
from husky_rover_mppi.utils import enable_compile_cache

if __name__ == "__main__":
    enable_compile_cache()
    raise SystemExit(main())
