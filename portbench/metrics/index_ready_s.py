"""index_ready_s: seconds from loading the index artifact (memory-mapped)
to the arrays and record tables the entry's calls read standing on the
card (`SaplingIndex.load`, `device_arrays`, and for plQuery
`query_records`, the record builders' launches), ended by a sync; the
harness's host-clock span in set-up."""


def read(run):
    return run.spans.get("index_ready")
