"""Gaussian diffusion: schedules, respacing, ancestral sampling."""
