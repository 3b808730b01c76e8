"""The plain reference: what the served window should produce, worked out again
from the inputs alone in float32 PyTorch (TF32 off), with no kernel, cache or batch.

It imports nothing of the program.  A configuration file names its model's module
here (``"reference": "dense"``); :mod:`.plan` re-derives Edgent's right-sizing
(the segments, the plan and each decode step's exit) from the configuration and
the traffic; :mod:`.common` holds the shared blocks, the pad prefix and the
lower-precision matmul of the control.
"""
