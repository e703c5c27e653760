"""Diffusion schedule and the DDIM / DDPM samplers."""
