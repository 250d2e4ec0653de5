"""Serving: a continuous-batching scheduler and a fine-feature cache around
the joint Coarse-Fine pipeline, a router over model variants and an HTTP
front end."""

from .feature_cache import CachingVideoServer, FeatureCache
from .http import InferenceHTTPServer
from .router import ModelRouter, UnknownModelError
from .scheduler import InferenceRequest, ServerOverloadedError, VideoServer

__all__ = ["CachingVideoServer", "FeatureCache", "InferenceHTTPServer",
           "InferenceRequest", "ModelRouter", "ServerOverloadedError",
           "UnknownModelError", "VideoServer"]
