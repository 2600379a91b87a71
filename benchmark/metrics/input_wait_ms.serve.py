"""Host ms a group that the dispatch loop waited for loaded scenes (the
port's ``serve.wait_input`` span around the loader queue's ``get``) in the
traced window's call: where the loader sets the pace."""

from benchmark import cells


def read(rec):
    call = cells.reader("loader_ms.serve").window_call(rec)
    if call is None or not call.counts.get("groups"):
        return None
    return call.total_ns("serve.wait_input") / call.counts["groups"] / 1e6
