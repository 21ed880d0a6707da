from .paging import KVPagePool, LOSSLESS_POLICY, PAPER_POLICY, PagePolicy
from .serving import ServeEngine, ServeStats

__all__ = ["KVPagePool", "LOSSLESS_POLICY", "PAPER_POLICY", "PagePolicy",
           "ServeEngine", "ServeStats"]
