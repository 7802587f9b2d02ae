from .evaluate import DecoderSetup, decode_and_score_track, evaluate_posteriorgrams

__all__ = ["DecoderSetup", "decode_and_score_track", "evaluate_posteriorgrams"]
