"""Core tensor/frame layer: layout conventions, resampling and warping."""
