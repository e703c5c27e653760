"""Pixel-space transforms of saliency maps and rgb normalisation."""
