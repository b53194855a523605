"""The runtime calls that block the host on the card inside the program's
``serve.call`` span (``eval/serving.py:make_serving_fn``'s ``serve``), per
call of the traced window; the benchmark's own synchronise and fetch
after each call lie outside it. Arithmetic: ``harness/spans.py:per_unit``."""

from harness.spans import is_sync, per_unit

# the program's span around a served call
SPANS = ("serve.call",)


def read(run):
    return per_unit(run, SPANS, is_sync)
