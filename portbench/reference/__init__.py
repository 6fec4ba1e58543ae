"""Plain PyTorch references of the configurations' forward passes, in
float32 with TF32 off.  They import nothing of the program and take no
weights from it: the harness draws the same weights from the seed again
(``portbench.weights``) and hands them over by name."""
