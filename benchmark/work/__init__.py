"""Work counts: the card's published peaks, the attention block's
operations and bytes from its shapes, and model FLOPs counted over the
plain reference on the meta device."""
