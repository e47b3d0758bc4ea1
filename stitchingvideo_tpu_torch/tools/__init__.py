"""Host-side tools: the chessboard calibration (`calibrate.py`)."""
