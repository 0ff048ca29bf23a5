"""Error taxonomy.

Mirrors the capability of the reference's single ExecutionError enum
(reference: src/error.rs:24-66) as a small exception hierarchy.
"""


class ExecutionError(Exception):
    """Base error for all engine failures (reference: error.rs:26)."""


class ParserError(ExecutionError):
    """SQL tokenizer/parser failure (reference: error.rs ParserError variant)."""


class PlanError(ExecutionError):
    """Query planning / type-coercion failure (reference: 'General' errors
    raised from sqlplanner.rs, e.g. no common supertype)."""


class InvalidColumnError(ExecutionError):
    """Unknown column reference (reference: error.rs InvalidColumn)."""


class NotImplementedError_(ExecutionError):
    """Feature recognized but not supported (reference: error.rs NotImplemented)."""


class InternalError(ExecutionError):
    """Engine invariant violation (reference: error.rs InternalError)."""
