"""Audio front-end: VGGish and the 296-d per-shot features."""
