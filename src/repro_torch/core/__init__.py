# The paper's primary contribution: joint DNN partitioning + right-sizing
# under a latency SLO, for static and dynamic bandwidth environments.
from repro_torch.core.graph import GraphLayer, InferenceGraph, lm_graph  # noqa: F401
from repro_torch.core.latency_model import (ProfileRecord,  # noqa: F401
                                            RegressionLatencyModel,
                                            RooflineLatencyModel,
                                            ScaledLatencyModel)
from repro_torch.core.partitioner import (CoInferencePlan,  # noqa: F401
                                          multi_branch_latency, optimize,
                                          optimize_multi,
                                          optimize_with_fallback,
                                          proportional_cuts)
from repro_torch.core.planner import EdgentPlanner  # noqa: F401
