"""The compression core: group-wise INT4 quantization, AWQ, the packed
linear and its runtime dispatch (the reference's `repro.core` names)."""
from repro_torch.core.awq import AWQConfig, search_awq_scale  # noqa: F401
from repro_torch.core.calibration import CalibrationCapture  # noqa: F401
from repro_torch.core.packing import (PackedLinear, pack_int4,  # noqa: F401
                                      unpack_int4)
from repro_torch.core.pipeline import (model_size_bytes,  # noqa: F401
                                       quantize_params)
from repro_torch.core.qlinear import (ExecutionConfig,  # noqa: F401
                                      execution_config, get_execution_config,
                                      qlinear_apply, set_execution_config)
from repro_torch.core.quantize import (QuantConfig,  # noqa: F401
                                       quantize_groupwise)
