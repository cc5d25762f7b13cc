"""Runnable flow cases of the port: `python -m diffpiso_tpu_torch.examples.pipe`
(plane channel flow against the analytic Poiseuille profile) and
`python -m diffpiso_tpu_torch.examples.karman_street` (the vortex street
behind a cylinder in a channel)."""
