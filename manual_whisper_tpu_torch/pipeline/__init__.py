from .chunking import SpeechChunk, merge_chunks, pad_audio_window
from .transcribe import TranscribePipeline, load_model

__all__ = ["SpeechChunk", "merge_chunks", "pad_audio_window",
           "TranscribePipeline", "load_model"]
