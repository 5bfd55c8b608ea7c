"""Modality frontend stubs (counterpart of the JAX package's
``models/frontends.py``): the backbone is real, the frontend is not.

``[audio]`` / ``[vlm]`` architectures receive *precomputed* frame/patch
embeddings; these helpers give their shapes and synthetic embeddings for
smoke runs and examples, drawn from an explicit ``torch.Generator``.

* whisper-small — the conv1d x2 + GELU frontend that maps 80-mel spectrogram
  frames to d_model embeddings is stubbed: inputs are post-conv frames
  (B, T, 768).  Real Whisper: T=1500 for 30 s audio.
* llava-next — the CLIP-ViT anyres tower + 2-layer MLP projector is stubbed:
  inputs are pre-projected patch embeddings (B, 2880, 4096); anyres tiling of
  a 672x672 image = (4 tiles + 1 base) x 576 patches.
"""

from __future__ import annotations

import torch

AUDIO_MEMORY_T = 1500  # whisper 30s encoder length used by serving


def _normal(generator: torch.Generator, shape, dtype) -> torch.Tensor:
    v = torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)
    return v.mul_(0.02).to(dtype)


def synth_audio_frames(generator: torch.Generator, batch: int, t: int, d_model: int,
                       dtype=torch.float32) -> torch.Tensor:
    """(batch, t, d_model) frames, normal x 0.02, on the generator's device."""
    return _normal(generator, (batch, t, d_model), dtype)


def synth_patches(generator: torch.Generator, batch: int, n_patches: int, d_model: int,
                  dtype=torch.float32) -> torch.Tensor:
    """(batch, n_patches, d_model) patch embeddings, normal x 0.02, on the
    generator's device."""
    return _normal(generator, (batch, n_patches, d_model), dtype)
