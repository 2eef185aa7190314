"""Engine core: host milliseconds to queue one chunk batch (the
``chunk_dispatch`` stage of ``EngineCore.timer``: staging, noise, the graph
replay's launch), the total over the window divided by the count."""


def read(win):
    seconds, count = win.stages.get("chunk_dispatch", (0.0, 0))
    return 1e3 * seconds / count if count else None
