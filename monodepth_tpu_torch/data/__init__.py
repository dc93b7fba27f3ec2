"""Data: the KITTI host path (split lists, calibration, velodyne GT, the
dataset, the threaded loader and the prefetch to the card), synthetic
trees and scenes, on-device augmentation."""
