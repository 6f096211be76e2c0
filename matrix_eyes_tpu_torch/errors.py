"""Error hierarchy with the same stage granularity as the reference (the
port's own copy of ``matrix_eyes_tpu/errors.py``).

The reference (Rust) uses typed error enums propagated to exit(1):
``ReconstructionError`` (reconstruction.rs:240-324), ``LoaderError`` /
``ModelError`` (depth_pro/mod.rs:420-504) and ``OutputError``
(output.rs:716-759). Here they become an exception hierarchy with the same
stage boundaries so the CLI can report which stage failed.
"""

from __future__ import annotations


class MatrixEyesError(Exception):
    """Base class for all matrix-eyes-tpu errors."""


class ReconstructionError(MatrixEyesError):
    """Top-level pipeline failure (image load, model, or output stage).

    Mirrors ``ReconstructionError`` at reference reconstruction.rs:240-249.
    """


class ImageError(ReconstructionError):
    """Source image could not be decoded / read (reconstruction.rs:246)."""


class ExifError(ReconstructionError):
    """EXIF metadata could not be parsed (reconstruction.rs:247)."""


class LoaderError(MatrixEyesError):
    """Checkpoint store failure. Mirrors ``LoaderError`` (mod.rs:420-427)."""


class CheckpointMissingKeys(LoaderError):
    """Required parameters absent from the checkpoint (mod.rs:241-243)."""

    def __init__(self, missing: list[str]):
        self.missing = list(missing)
        preview = ", ".join(self.missing[:8])
        more = "" if len(self.missing) <= 8 else f" (+{len(self.missing) - 8} more)"
        super().__init__(f"Recorder missing items: {preview}{more}")


class CheckpointBadShape(LoaderError):
    """A checkpoint tensor's shape/dtype does not match the model (mod.rs:238-240)."""


class ModelError(MatrixEyesError):
    """Model stage failure. Mirrors ``ModelError`` (mod.rs:485-504)."""


class OutputError(MatrixEyesError):
    """Output stage (render / mesh write) failure. Mirrors output.rs:716-759."""
