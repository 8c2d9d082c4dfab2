"""The plain reference the benchmark holds the program to: plain PyTorch
and NumPy, importing nothing of the program. Frozen copies of the recipes
it follows (the LSTM loop, the alignment DP, the SGD update), so that a
change to the program cannot move them. Each layer graph has a family file
here, named by its configurations' "reference" key (bidi.py; what it
defines: registry.family); train.py, ctc.py and precision.py serve every
family."""
