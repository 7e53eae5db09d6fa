from .conv3d import conv3d_3x3_same, conv3d_3x3_same_plain
