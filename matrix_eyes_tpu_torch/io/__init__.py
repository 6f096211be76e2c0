"""Host-side IO: image decode + EXIF metadata (reference reconstruction.rs:74-153)."""
