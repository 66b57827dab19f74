"""The yardstick's arithmetic: the card's peaks (``peaks``), each kernel's
operations and bytes (``kernels``, frozen copies of the port's ``cost``
functions) and the model FLOPs per token (``model``, by each family's file
under ``families/``)."""
