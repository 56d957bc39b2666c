"""Host seconds to make the weights from the seed and pack every linear
to int4 (`core.pipeline.quantize_params`)."""


def read(run):
    return run.spans.get("weights")
