"""ProtGram-DirectGCN on PyTorch and CUDA (NVIDIA Hopper).

A port of ``protgram_directgcn_tpu`` that imports nothing of it: the n-gram
graph ETL, the DirectGCN model and the hierarchical trainer of
``--stages graph,gcn``, with the hypercube propagation kernels K1/K2 written
in CUDA C++ (``csrc/hyper.cu``).
"""
