"""Plain references: the models in float32, the engine's tokenisation
and targets, and the scheduler's decisions. They import nothing of the
program."""
