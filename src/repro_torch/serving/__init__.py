from repro_torch.serving.engine import (CoInferenceStepper, Request,  # noqa: F401
                                        ServeStats, ServingEngine,
                                        quantize_bw)
