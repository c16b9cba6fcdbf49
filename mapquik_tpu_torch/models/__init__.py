"""Named parameter presets for the reference's published run configurations
(the port's copy of `mapquik_tpu.models`)."""

from . import presets  # noqa: F401
