"""Serving: a continuous-batching scheduler and a fine-feature cache around
the joint Coarse-Fine pipeline."""

from .feature_cache import CachingVideoServer, FeatureCache
from .scheduler import InferenceRequest, ServerOverloadedError, VideoServer

__all__ = ["CachingVideoServer", "FeatureCache", "InferenceRequest",
           "ServerOverloadedError", "VideoServer"]
