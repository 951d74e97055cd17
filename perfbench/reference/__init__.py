"""The plain reference: the StarCoder2-shaped decoder, its loss and
AdamW, in float32 PyTorch (TF32 off), written from the published
description and the configuration file alone.  It imports nothing of
the program, and is handed only the weights and tokens the benchmark
made from the seed."""
