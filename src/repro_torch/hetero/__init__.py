from .monitor import GroupMonitor
from .rebalance import (DynamicPolicy, HGuidedPolicy, RebalancePolicy,
                        StaticPolicy, make_policy)
from .sharder import ExecutableCache, quantize_shares
from .trainer import HeteroTrainer, StepReport

__all__ = ["DynamicPolicy", "ExecutableCache", "GroupMonitor",
           "HGuidedPolicy", "HeteroTrainer", "RebalancePolicy",
           "StaticPolicy", "StepReport", "make_policy", "quantize_shares"]
