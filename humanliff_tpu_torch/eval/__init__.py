"""Sample-fidelity metrics."""
