"""Host ms a scene in the server's loader stage (the port's
``serve.load`` and ``serve.prep`` spans around ``load_scene`` and
``prepare_scene``) in the traced window's call."""


def window_call(rec):
    """The traced window's ``serve.call`` unit, for every serve reader:
    the first whose scenes are the record's (the warm and sizing calls,
    16 and 32 scenes, come before it; the profiled call after); None
    where the port records none (a tree without ``utils/tracing.py``)."""
    if rec.get("kind") != "serve" or not rec.get("scenes"):
        return None
    try:
        from jspsr_torch.utils import tracing
    except ImportError:
        return None
    return next((u for u in tracing.units("serve.call")
                 if u.counts.get("scenes") == rec["scenes"]), None)


def read(rec):
    call = window_call(rec)
    if call is None:
        return None
    return (call.total_ns("serve.load") + call.total_ns("serve.prep")) \
        / rec["scenes"] / 1e6
