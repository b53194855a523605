"""Spectrogram-domain feature math."""

from .specs import source_coordinates, znorm

__all__ = ["source_coordinates", "znorm"]
