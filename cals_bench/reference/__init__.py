"""The benchmark's plain references: plain PyTorch, NumPy and SciPy, which
import nothing of the measured program."""
