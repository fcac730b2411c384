from .flacenc import encode_flac, write_flac
from .io import (SAMPLE_RATE, UnsupportedFormatError, decodable_suffixes,
                 decode_wav_bytes, load_audio, write_wav)
from .resample import resample_poly, to_mono

__all__ = ["SAMPLE_RATE", "UnsupportedFormatError", "decodable_suffixes",
           "decode_wav_bytes", "encode_flac", "load_audio", "write_flac",
           "write_wav", "resample_poly", "to_mono"]
