"""Seconds inside the program's set-up spans (`setup.kernel_library`: the
kernel library's build or cache hit and its load; `setup.k4_first_call`:
the first call of the K4 op), each recorded once per process on the host's
clock. The runners' warm-up reaches them, before the first timed step."""
from port_bench import spans


def read(m):
    return spans.setup_seconds()
