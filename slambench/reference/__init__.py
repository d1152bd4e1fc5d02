"""Plain references the benchmark judges the program's outputs by. They
import nothing of the program (rgbdslam_tpu_torch) and nothing of JAX."""
