from .fault import (ElasticTrainer, FailureInjector, StragglerMonitor)

__all__ = ["ElasticTrainer", "FailureInjector", "StragglerMonitor"]
