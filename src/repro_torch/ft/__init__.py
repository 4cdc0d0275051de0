from .supervisor import (FailurePlan, InjectedFailure, Supervisor,
                         SupervisorReport)

__all__ = ["FailurePlan", "InjectedFailure", "Supervisor",
           "SupervisorReport"]
