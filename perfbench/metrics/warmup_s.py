"""Host seconds for the engine's pools and its warm-up dispatches
(`GenerationEngine.warmup` and the widest context)."""


def read(run):
    return run.spans.get("warmup")
