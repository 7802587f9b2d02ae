from .stft import SinebellSTFT, jdc_spectrogram, stft_frames
from .cfp import CFP, CFPConfig, MSNET_CFP, FTANET_CFP, TONET_CFP

__all__ = [
    "SinebellSTFT",
    "jdc_spectrogram",
    "stft_frames",
    "CFP",
    "CFPConfig",
    "MSNET_CFP",
    "FTANET_CFP",
    "TONET_CFP",
]
