"""Hardware models, the baselines' analytic models and the pipeline
simulator: the port's copy of ``repro/sim``, plain Python arithmetic
that gives the same floats, with an H100 spec in place of the TPU's."""
