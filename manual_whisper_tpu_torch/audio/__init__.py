from .io import (SAMPLE_RATE, UnsupportedFormatError, decode_wav_bytes,
                 load_audio, write_wav)
from .resample import resample_poly, to_mono

__all__ = ["SAMPLE_RATE", "UnsupportedFormatError", "decode_wav_bytes",
           "load_audio", "write_wav", "resample_poly", "to_mono"]
