from .bpe import ByteLevelBPE, bytes_to_unicode
from .whisper_tokens import LANGUAGES, SpecialTokens, WhisperTokenizer, make_test_tokenizer

__all__ = ["ByteLevelBPE", "bytes_to_unicode", "LANGUAGES", "SpecialTokens",
           "WhisperTokenizer", "make_test_tokenizer"]
