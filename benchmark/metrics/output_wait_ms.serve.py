"""Host ms a group that the dispatch loop waited for room in the writer's
queue (the port's ``serve.wait_output`` span) in the traced window's call:
where the writer sets the pace."""

from benchmark import cells


def read(rec):
    call = cells.reader("loader_ms.serve").window_call(rec)
    if call is None or not call.counts.get("groups"):
        return None
    return call.total_ns("serve.wait_output") / call.counts["groups"] / 1e6
