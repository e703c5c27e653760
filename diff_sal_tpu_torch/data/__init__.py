"""Data feeding: saliency-map transforms and rgb normalisation, the
synthetic, visual (DHF1K, Hollywood2, UCF-Sports) and audio-visual
datasets, the packed uint8 format and the threaded loader."""
