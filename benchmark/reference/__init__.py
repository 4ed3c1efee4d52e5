"""The benchmark's plain reference of the measured system, in plain PyTorch.

It is a frozen, self-contained statement of what the served and trained
models compute: the K-iteration LISTA loops in 2D and 3D on F.conv*d,
the Denoiser's bucket pad and crop, the MAD noise estimate with the
bior4.4 filter, the mse loss, Adam after global-norm clipping, the
projection, and the training corpora's crop protocol. It imports nothing
of the program under test, and takes none of its weights or tables.
"""
