"""BlinkQL service layer of the port (counterpart of `repro.service`): the
paper's user-facing contract (§2) on top of the core engine — a SQL dialect with `ERROR WITHIN x% CONFIDENCE y%` /
`WITHIN n SECONDS` clauses, served to many concurrent sessions through an
admission scheduler that coalesces compatible queries into shared scans,
backed by a generation-validated answer cache and a workload monitor that
drives §3.2 re-optimization on template churn. See docs/SERVICE.md."""
from repro_torch.service.cache import AnswerCache, CacheStats
from repro_torch.service.parser import (BlinkQLError, Explain, ShowMetrics,
                                  parse_blinkql, parse_statement)
from repro_torch.service.scheduler import (AdmissionError, BlinkQLService,
                                     DeadlineShedError, DegradedServiceError,
                                     ServiceConfig, ServiceUnhealthyError)
from repro_torch.service.workload import WorkloadConfig, WorkloadMonitor

__all__ = [
    "AnswerCache", "CacheStats", "BlinkQLError", "parse_blinkql",
    "parse_statement", "ShowMetrics", "Explain",
    "AdmissionError", "BlinkQLService", "ServiceConfig",
    "DeadlineShedError", "DegradedServiceError", "ServiceUnhealthyError",
    "WorkloadConfig", "WorkloadMonitor",
]
