from .pipeline import DataConfig, ShardedTokenStream, make_train_iterator

__all__ = ["DataConfig", "ShardedTokenStream", "make_train_iterator"]
