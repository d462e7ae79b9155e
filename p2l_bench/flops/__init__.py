"""The operations and bytes that the roofline and ``mfu`` metrics divide:
the card's peaks, the least time of a piece of work, the hand-written
kernels' and their modules' work, and the model's FLOPs counted over the
plain reference."""
