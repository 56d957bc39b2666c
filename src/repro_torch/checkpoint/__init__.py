from repro_torch.checkpoint.checkpointer import (AsyncCheckpointer, latest_step,  # noqa: F401
                                                 restore, save)
