"""The yardstick of the device metrics: the card's peaks and the bytes
each kernel family and each whole step must move."""
