"""The inference demo on a log dir that the custom-dataset train driver wrote
(the reference keeps a demo.py copy per dataset directory); see
``examples/demo.py``.

    python -m mask_rcnn_tpu_torch.examples.custom_dataset.demo LOG_DIR --images IMG ...
"""

from mask_rcnn_tpu_torch.examples.demo import main

if __name__ == "__main__":
    main()
