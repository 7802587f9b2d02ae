from .array_file import load_array, save_array

__all__ = ["load_array", "save_array"]
