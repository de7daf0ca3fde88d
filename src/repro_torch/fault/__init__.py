"""Fault tolerance of the port (counterpart of `repro.fault`): deterministic
injection (inject), supervision primitives (supervisor), and the error
vocabulary of the degradation ladder. See docs/FAULTS.md for the fault
model end to end."""
from repro_torch.fault.inject import (AllShardsLostError, FaultError,
                                      FaultPlan, FaultSpec, InjectedFault,
                                      ShardScanError, arm, random_plan)
from repro_torch.fault.supervisor import (Heartbeat, RetryLoop,
                                          StragglerPolicy, elastic_plan)

__all__ = [
    "AllShardsLostError", "FaultError", "FaultPlan", "FaultSpec",
    "InjectedFault", "ShardScanError", "arm", "random_plan",
    "Heartbeat", "RetryLoop", "StragglerPolicy", "elastic_plan",
]
