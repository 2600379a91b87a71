"""Host ms per scene in the server's loader stage (load_scene then
prepare_scene, each timed around its call), over the traced window."""


def read(rec):
    if rec.get("kind") != "serve":
        return None
    spans = rec["spans"].ns
    reads, preps = spans.get("scene_read"), spans.get("scene_prep")
    if not reads:
        return None
    return (sum(reads) + sum(preps or [])) / len(reads) / 1e6
