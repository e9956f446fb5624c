from .cache import enable_compile_cache
from .timer import ScopedTimer, timed

__all__ = ["ScopedTimer", "enable_compile_cache", "timed"]
