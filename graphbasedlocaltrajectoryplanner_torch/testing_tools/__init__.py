"""Simulation dummies for closed-loop testing (reference
graph_ltpl/testing_tools/): ideal-controller vehicle model and opponent
object-list generator.  The port's own copies of the JAX package's
``testing_tools``."""
