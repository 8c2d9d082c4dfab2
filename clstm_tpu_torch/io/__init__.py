""".clstm model files, line normalization, PNG I/O."""
