"""The plain reference the benchmark holds the program to: plain PyTorch
and NumPy, importing nothing of the program. Frozen copies of the recipes
it follows (the LSTM loop, the alignment DP, the SGD update), so that a
change to the program cannot move them."""
