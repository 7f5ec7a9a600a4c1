"""The port's operators: kernels on the card, plain versions on the CPU."""
