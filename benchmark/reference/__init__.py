"""The plain reference of the benchmark's cells: NumPy only.

It imports nothing of the program and takes nothing the program made.
From a configuration file and the disturbances the harness draws, it
works out the controller's gains and the estimator and selector
matrices, and runs the closed loops itself.  ``loop.reference_episodes``
is the entry point.
"""
