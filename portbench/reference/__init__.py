"""The plain PyTorch reference that decides `correct`: frozen copies of the
port's plain versions (decode, projection, rasterizer with its capacity
caps, composites, loss, Adam), differentiated by autograd. It loads
nothing of `lidargs_torch` and takes only the benchmark's inputs."""
