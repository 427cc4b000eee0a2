"""``setup_s``: process start to the first timed call: imports, the kernels
loaded (built on a checkout's first run), the inputs generated, planning
and staging, warm-up."""


def compute(rec: dict):
    return rec["setup_s"]
