"""host_call_us: the host's time inside the program's call a request
(`SaplingIndex.query_device` / `binsearch_device` down to the ctypes
launch: checks, allocation, launch), from the call to its return,
summed over the measured window's requests and divided by their count."""


def read(run):
    if not run.host_call_s:
        return None
    return 1e6 * sum(run.host_call_s) / len(run.host_call_s)
