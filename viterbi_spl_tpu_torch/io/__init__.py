from .array_file import load_array, save_array
from .wav import load_wav, save_wav, wav_info

__all__ = ["load_array", "save_array", "load_wav", "save_wav", "wav_info"]
