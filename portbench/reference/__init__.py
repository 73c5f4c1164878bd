"""Plain references of the benchmark's sampler steps.

Plain PyTorch, written from the models' published equations. Nothing here
imports the program under test or the JAX package, and nothing here takes
a value the program made but the outputs it judges: the models' constants,
the filters, factors, draws and weights are worked out again here from the
data, the chain state and the step's noise.
"""
