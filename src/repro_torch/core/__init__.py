"""BlinkDB core of the port (counterpart of `repro.core`)."""
from repro_torch.core.engine import BlinkDB, EngineConfig
from repro_torch.core.types import (AggOp, Answer, Atom, BoundUnreachableError,
                                    CmpOp, Conjunction, ErrorBound, Predicate,
                                    Query, QueryTemplate, TimeBound)

__all__ = [
    "BlinkDB", "EngineConfig", "AggOp", "Answer", "Atom",
    "BoundUnreachableError", "CmpOp", "Conjunction", "ErrorBound",
    "Predicate", "Query", "QueryTemplate", "TimeBound",
]
