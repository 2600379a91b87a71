"""Host ms a group in ``scene_dispatch_batch`` (the port's
``serve.dispatch`` span: upload, the runner's launches, the event) in the
traced window's call: where the dispatching thread sets the pace."""

from benchmark import cells


def read(rec):
    call = cells.reader("loader_ms.serve").window_call(rec)
    if call is None or not call.counts.get("groups"):
        return None
    return call.total_ns("serve.dispatch") / call.counts["groups"] / 1e6
