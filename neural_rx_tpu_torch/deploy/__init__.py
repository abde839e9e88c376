"""The deployed receiver: the Aerial-ABI engine (`aerial.py`), one engine
and CUDA graph per PRB bucket with pad-to-bucket dispatch and engine files
(`aot.py`), and Aerial-layout test vectors (`data_tools.py`)."""
