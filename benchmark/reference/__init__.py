"""The benchmark's plain reference: NumPy only.

It imports nothing of the program under test and takes nothing the program
made: it works the parameters, the states, the segments and the messages out
again from the same samples the benchmark hands the program.
"""
