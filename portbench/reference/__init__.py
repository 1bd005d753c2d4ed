"""Plain reference of what the benchmarked program computes; imports
nothing of the program."""
