"""The runtime's kernel launches inside the program's ``serve.call`` span,
per call of the traced window. Arithmetic: ``harness/spans.py:per_unit``."""

from harness.spans import is_launch, per_unit

# the program's span around a served call
SPANS = ("serve.call",)


def read(run):
    return per_unit(run, SPANS, is_launch)
