"""The yardstick's counts: datasheet peaks and the least bytes of each
sparse product, computed from shapes."""
