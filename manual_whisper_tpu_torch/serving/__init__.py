from .jobs import InferenceBackend, JobStore, PipelineBackend, RateLimiter
from .server import create_server, serve

__all__ = ["InferenceBackend", "JobStore", "PipelineBackend", "RateLimiter",
           "create_server", "serve"]
