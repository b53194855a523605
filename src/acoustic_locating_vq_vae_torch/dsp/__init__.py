"""DSP: the STFT frontend, FFT convolution and the high-pass, image-source
RIR synthesis, and the spectrogram feature math."""

from .filters import fft_convolve, highpass_habets
from .rir import beta_from_rt60, beta_from_rt60_traced, generate_rir, generate_rir_batch
from .specs import rir_spec_ratio, source_coordinates, wiener_estimate, znorm
from .stft import griffin_lim, griffin_lim_from_angle, hann_window, inverse_spectrogram, istft, power_to_db, spectrogram, stft

__all__ = [
    "beta_from_rt60", "beta_from_rt60_traced", "fft_convolve", "generate_rir", "generate_rir_batch",
    "griffin_lim", "griffin_lim_from_angle", "hann_window", "highpass_habets", "inverse_spectrogram", "istft", "power_to_db",
    "rir_spec_ratio", "source_coordinates", "spectrogram", "stft", "wiener_estimate", "znorm",
]
