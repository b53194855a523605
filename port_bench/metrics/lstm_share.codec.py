"""The share of the card's busy time in the kernels cuDNN's RNN launches
under the LSTM operator (``aten::lstm``: the encoder's and the decoder's
two-layer LSTMs, 750 steps each) in the traced codec window.

The profiler counts each such kernel twice: under the operator and again
under the runtime call inside it that launched it (``cudaLaunchKernel``,
``cudaMemsetAsync``; cuDNN's RNN launches through the runtime, its convs do
not), so the operator's device time (``harness/trace.py:device_s_under``)
less that of the runtime calls under it is each kernel once."""

from harness.trace import device_s_under

# the host operation whose kernels are the recurrence's
OPS = ("aten::lstm",)
# CUDA's API calls (cudaLaunchKernel, cuLaunchKernel, ...), by the start of their names
RUNTIME = ("cuda", "cu")


def read(run):
    t = run.get("trace")
    if not t or not t.get("busy_s"):
        return None
    under = device_s_under(t, OPS)
    twice = sum(s for name, s, around in t.get("host_ops", ()) if name.startswith(RUNTIME) and set(OPS) & set(around))
    return 100.0 * (under - twice) / t["busy_s"] if under > twice else None
