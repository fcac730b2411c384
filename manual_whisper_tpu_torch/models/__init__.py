from .whisper import (MODEL_CONFIGS, WhisperConfig, decode_step,
                      decoder_forward, encode, init_params,
                      precompute_cross_kv)

__all__ = ["MODEL_CONFIGS", "WhisperConfig", "decode_step",
           "decoder_forward", "encode", "init_params", "precompute_cross_kv"]
