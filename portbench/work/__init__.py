"""The yardstick's arithmetic: the operations and bytes the configured
work needs, counted from shapes (2·M·N·K a product), and the card's peaks."""
