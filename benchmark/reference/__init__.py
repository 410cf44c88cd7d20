"""Plain PyTorch references of the detect and match paths. They import
nothing of the measured program."""
